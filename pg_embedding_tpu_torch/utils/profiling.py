"""Tracing / profiling helpers — the counterpart of
pg_embedding_tpu/utils/profiling.py.

  * ``trace(logdir)``     — context manager around ``torch.profiler``
                            (CPU activity, and CUDA activity when a card is
                            present) that writes a Chrome trace,
                            ``logdir/trace.json``.
  * ``sync(tree)``        — wait for the card: ``torch.cuda.synchronize``
                            of each CUDA device holding a tensor in
                            ``tree``; a no-op for host tensors.
  * ``Timer``             — wall-clock phase timer with an optional sync.
  * ``SearchStatsAgg``    — aggregates per-query walk counters (hops,
                            distance evaluations) across calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler and write its Chrome trace to
    ``logdir/trace.json``; yields the profiler (``key_averages()`` gives
    the per-op sums)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):       # NamedTuples included
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Block until the card has finished the work producing the CUDA
    tensors in ``tree`` (a tensor, or nested lists, tuples and dicts of
    them); host tensors need no wait."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Phase timer: ``with timer.phase("build"): ...`` accumulates seconds."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree=None):
        t0 = time.time()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.time() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "; ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}x" for k, v in
            sorted(self.seconds.items()))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SearchStatsAgg:
    """Aggregate core.search.SearchStats across calls."""

    def __init__(self) -> None:
        self.n_queries = 0
        self.total_hops = 0
        self.total_dist_evals = 0
        self.max_hops = 0

    def add(self, stats) -> None:
        hops = _host(stats.hops)
        evals = _host(stats.dist_evals)
        self.n_queries += hops.size
        self.total_hops += int(hops.sum())
        self.total_dist_evals += int(evals.sum())
        self.max_hops = max(self.max_hops, int(hops.max()))

    def summary(self) -> Dict[str, float]:
        q = max(self.n_queries, 1)
        return {
            "queries": self.n_queries,
            "mean_hops": self.total_hops / q,
            "mean_dist_evals": self.total_dist_evals / q,
            "max_hops": self.max_hops,
        }
