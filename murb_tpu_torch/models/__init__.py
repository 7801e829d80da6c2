"""Implementation registry: the port's ``--im`` factory.

Port of ``murb_tpu/models/__init__.py`` (ref: src/murb/main.cpp:205-270),
with the same API and every tag of it.  Reference tags are accepted as
aliases.  A tag that ``murb_tpu`` registers but this package did not carry
would be listed in ``NOT_YET_PORTED`` (``validate_tag`` raises "not yet
ported" for it); "does not exist" is for tags neither package knows.
"""
from __future__ import annotations

from typing import Callable

from murb_tpu_torch.core.state import BodyState

_REGISTRY: dict[str, Callable] = {}
_ALIASES: dict[str, str] = {}

#: murb_tpu tags (and their aliases) not ported yet
NOT_YET_PORTED: tuple[str, ...] = ()

#: block geometry options of the exact sweep engines (K3, K4, K13)
_BLOCKS = ("block_i", "block_j", "autotune")

#: options of the tracked engines (murb_tpu's registry forwards the same)
_TRACKED = ("num_iterations", "acc_fn", "metric_dtype", "metrics_method",
            "metrics_proxy_m", "fused_proxy_m", "fused_fmm",
            "fused_adaptive", "m2l_dots", "validated_half")


def register(tag: str, factory: Callable, aliases: tuple[str, ...] = ()):
    _REGISTRY[tag] = factory
    for a in aliases:
        _ALIASES[a] = tag


def resolve_tag(tag: str) -> str:
    return _ALIASES.get(tag, tag)


def available_implementations() -> dict[str, tuple[str, ...]]:
    """tag -> aliases, for --list-impls and docs."""
    return {t: tuple(a for a, t2 in _ALIASES.items() if t2 == t)
            for t in _REGISTRY}


def validate_tag(tag: str) -> str:
    """Resolve a tag or raise: NotImplementedError for a ``murb_tpu`` tag
    not ported yet, ValueError for an unknown one (the reference exits
    with "Implementation '...' does not exist", ref: main.cpp:265-268)."""
    canonical = resolve_tag(tag)
    if canonical in _REGISTRY:
        return canonical
    if tag in NOT_YET_PORTED:
        raise NotImplementedError(
            f"Implementation {tag!r} is not yet ported to murb_tpu_torch "
            "(ROADMAP.md Queue 1)")
    known = ", ".join(sorted(set(_REGISTRY) | set(_ALIASES)))
    raise ValueError(f"Implementation {tag!r} does not exist. "
                     f"Available: {known}")


def create_engine(tag: str, bodies: BodyState, **kwargs):
    """Build an engine by tag; unknown tags raise with the available list."""
    return _REGISTRY[validate_tag(tag)](bodies, **kwargs)


def _filter(kwargs, *names):
    return {k: v for k, v in kwargs.items()
            if k in names or k in ("soft", "dt")}


def _build_registry():
    from murb_tpu_torch.models import engines as E

    register("xla+naive", lambda b, **kw: E.NaiveEngine(b, **_filter(kw)),
             aliases=("cpu+naive", "naive"))
    register("nop", lambda b, **kw: E.NopEngine(b, **_filter(kw)),
             aliases=("cpu+nop",))
    register("xla+chunked",
             lambda b, **kw: E.ChunkedEngine(b, **_filter(kw, "chunk")),
             aliases=("cpu+optim", "cpu+simd", "cpu+omp", "xla+fused"))
    register("tpu+tile",
             lambda b, **kw: E.PallasTileEngine(b, **_filter(kw, *_BLOCKS)),
             aliases=("gpu+tile",))
    register("tpu+hybrid",
             lambda b, **kw: E.HybridEngine(
                 b, **_filter(kw, "passes", *_BLOCKS)),
             aliases=("gpu+tile+full", "gpu+tile+full200k",
                      "tpu+tile+full", "tpu+tile+full200k"))
    register("tpu+proxy",
             lambda b, **kw: E.ProxyEngine(
                 b, **_filter(kw, "m", "cells", "levels", "tol", "max_m",
                              "heavy_k", "box_margin", "adapt_every",
                              "cost_slack", "m2l_dots", "validate",
                              "near")),
             aliases=("fmm", "barnes-hut"))
    register("tpu+hybrid+fast",
             lambda b, **kw: E.HybridEngine(b, passes=1,
                                            **_filter(kw, *_BLOCKS)))
    register("tpu+hybrid+x3",
             lambda b, **kw: E.HybridEngine(b, passes=3,
                                            **_filter(kw, *_BLOCKS)))
    register("tpu+mxu",
             lambda b, **kw: E.MXUEngine(
                 b, **_filter(kw, "precision", *_BLOCKS)))
    register("tpu+tracking",
             lambda b, **kw: E.TrackingEngine(
                 b, **_filter(kw, *_TRACKED, "history", "fused_exact")),
             aliases=("gpu+tracking",))
    register("tpu+tracking+multi",
             lambda b, **kw: E.MultiGalaxyTrackingEngine(
                 b, **_filter(kw, *_TRACKED, "masks", "fused_exact")),
             aliases=("gpu+tracking+multi",))
    register("tpu+leapfrog",
             lambda b, **kw: E.LeapfrogEngine(
                 b, **_filter(kw, "num_iterations", "acc_fn")),
             aliases=("gpu+leapfrog",))
    register("tpu+leapfrog+tracking",
             lambda b, **kw: E.LeapfrogTrackingEngine(
                 b, **_filter(kw, *_TRACKED, "history")),
             aliases=("gpu+leapfrog+tracking",))
    register("tpu+kdk", lambda b, **kw: E.KDKEngine(b, **_filter(kw, "acc_fn")))
    register("tpu+yoshida4",
             lambda b, **kw: E.Yoshida4Engine(b, **_filter(kw, "acc_fn")))

    # the distributed engines (murb_tpu_torch.parallel), imported at first
    # use; ``devices`` (the port's) may put several shards on one card
    def _shard(mode):
        def factory(b, **kw):
            from murb_tpu_torch.parallel.shard_engine import ShardedEngine

            return ShardedEngine(b, mode=mode, **_filter(
                kw, "shards", "gpu_fraction", "block_i", "block_j",
                "ring_impl", "kernel", "m", "levels", "m2l_dots", "validate",
                "adapt_every", "devices"))

        return factory

    register("shard+allgather", _shard("allgather"), aliases=("mpi",))
    register("shard+ring", _shard("ring"))
    register("shard+uneven", _shard("uneven"), aliases=("hetero",))
    register("shard+proxy", _shard("proxy"))
    register("shard+fmm", _shard("fmm"))
    register("shard+adaptive", _shard("adaptive"))


_build_registry()
