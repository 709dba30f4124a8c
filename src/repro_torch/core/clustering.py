"""Incremental single-pass object clustering (Focus §4.2).

Semantics (paper): put the first object in cluster c1. For each new object
with feature f, assign it to the closest centroid within L2 distance T and
update that centroid's running mean; otherwise open a new cluster at f. The
cluster count is bounded by M; when the buffer fills, the *smallest*
clusters are evicted to the top-K index (handled by the ingestor
between batches) — complexity stays O(M·n).

Three implementations, as in the JAX package:
  * ``cluster_scan``   — canonical sequential semantics, one object at a
                         time (the oracle; exactly the paper's algorithm).
  * ``cluster_batched``— two-phase variant: the ``centroid_assign`` kernel
                         scores the whole batch against the *batch-start*
                         centroid table; objects that match no existing
                         centroid are resolved sequentially within the
                         batch.
  * ``cluster_fused``  — the fast path: phase-1 matched objects fold into
                         their centroids in ONE segment sum, and the
                         sequential rule runs only over the gathered
                         *unmatched* rows before ids are scattered back.

State lives on the device the caller chose (``init_state(device=...)``).
Every function returns a new state and leaves its input state untouched,
as the JAX package's pure functions do; the sequential loops update their
own copy in place. The sequential rule never reads a device value on the
host: each step is a handful of tensor ops (``torch.where`` instead of a
branch), so a loop over U rows queues work without waiting for the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.hopper import ops as hops
from repro_torch.hopper.ref import threshold_sq


class ClusterState(NamedTuple):
    centroids: torch.Tensor    # (M, D) float32; rows >= n are undefined
    counts: torch.Tensor       # (M,) int32 (0 for empty slots)
    n: torch.Tensor            # 0-d int32: live cluster count


def init_state(max_clusters: int, feat_dim: int,
               device: DeviceLike = "cuda") -> ClusterState:
    dev = resolve_device(device)
    return ClusterState(
        centroids=torch.zeros((max_clusters, feat_dim), dtype=torch.float32,
                              device=dev),
        counts=torch.zeros((max_clusters,), dtype=torch.int32, device=dev),
        n=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _as_feats(feats, device: torch.device) -> torch.Tensor:
    if isinstance(feats, torch.Tensor):
        return feats.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(feats, np.float32)).to(device)


class _Scan:
    """The sequential rule over a private copy of a state: ``step`` assigns
    one feature (in place) and returns its cluster id as a 0-d tensor.
    ``valid`` False makes the step a no-op that returns -1. It is
    ``_StackedScan`` at one slot, on views of the copy."""

    def __init__(self, state: ClusterState, threshold: float):
        dense = torch.contiguous_format
        self.cent = state.centroids.clone(memory_format=dense)
        self.counts = state.counts.clone(memory_format=dense)
        self.n = state.n.clone()
        self._one = _StackedScan(
            ClusterState(self.cent[None], self.counts[None], self.n.view(1)),
            threshold)
        self.true = torch.ones((1,), dtype=torch.bool,
                               device=self.cent.device)

    def step(self, f: torch.Tensor, valid: Optional[torch.Tensor] = None):
        valid = self.true if valid is None else valid.view(1)
        return self._one.step(f[None], valid)[0]

    def state(self) -> ClusterState:
        return ClusterState(self.cent, self.counts, self.n)


def _ids(ids, device: torch.device) -> torch.Tensor:
    if not ids:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return torch.stack(ids).to(torch.int32)


def cluster_scan(state: ClusterState, feats, threshold: float):
    """Sequential clustering of feats (B, D). Returns (state, ids (B,))."""
    feats = _as_feats(feats, state.centroids.device)
    scan = _Scan(state, threshold)
    ids = [scan.step(f) for f in feats]
    return scan.state(), _ids(ids, feats.device)


# ---------------------------------------------------------------------------
# two-phase batched variant
# ---------------------------------------------------------------------------

def _phase1(state: ClusterState, feats: torch.Tensor, threshold: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel distances against the batch-start centroid table: the
    one-slot case of ``_phase1_stacked``."""
    j, matched = _phase1_stacked(state.centroids[None], state.n.view(1),
                                 feats[None], threshold)
    return j[0], matched[0]


def _phase1_stacked(centroids: torch.Tensor, n: torch.Tensor,
                    feats: torch.Tensor, threshold: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 for S stream slots in one kernel launch: feats (S, B, D)
    against the stacked tables centroids (S, M, D) with live counts n
    (S,). Each slot's dead rows (>= its n) are pushed to a far sentinel so
    the kernel's online argmin never selects them; the threshold compare
    is fused into the kernel."""
    M = centroids.shape[1]
    live = (torch.arange(M, device=feats.device)[None, :]
            < n[:, None])[:, :, None]
    masked = torch.where(live, centroids, 1e9)
    _, j, matched = hops.centroid_assign_stacked(feats, masked,
                                                 threshold=threshold)
    return j, matched


def cluster_batched(state: ClusterState, feats, threshold: float):
    """Two-phase batched clustering. Returns (state, ids (B,)).

    Phase 1 (parallel, kernel): distances of the whole batch against the
    batch-start centroids -> matched mask. Phase 2 (sequential): matched
    objects fold into their centroid; unmatched objects run the sequential
    rule so within-batch new clusters behave exactly like
    ``cluster_scan``.
    """
    feats = _as_feats(feats, state.centroids.device)
    if len(feats) == 0:
        return state, torch.zeros((0,), dtype=torch.int32,
                                  device=feats.device)
    j, matched = _phase1(state, feats, threshold)
    # focuslint: disable=host-sync -- the designed per-batch fetch of the
    # staged path: matched decides which branch each row takes
    matched_np = matched.cpu().numpy()
    scan = _Scan(state, threshold)
    ids = []
    for f, jj, m in zip(feats, j.long(), matched_np):
        if m:
            cid = jj.reshape(1)
            cnt = scan.counts.index_select(0, cid) + 1
            c = scan.cent.index_select(0, cid)
            scan.cent.index_copy_(0, cid, c + (f[None, :] - c) / cnt[:, None])
            scan.counts.index_copy_(0, cid, cnt)
            ids.append(jj)
        else:
            ids.append(scan.step(f))
    return scan.state(), _ids(ids, feats.device)


# ---------------------------------------------------------------------------
# fused fast path: segment-sum fold + unmatched-only scan
# ---------------------------------------------------------------------------

def _fold_matched(state: ClusterState, feats: torch.Tensor, j: np.ndarray,
                  matched: np.ndarray) -> ClusterState:
    """Fold every phase-1-matched object into its centroid in one shot:
    ``(c·cnt + Σf) / max(cnt + k, 1)``, which equals k sequential
    running-mean folds up to float association. Returns a new state
    (``_fold_matched_`` folds in place)."""
    if not matched.any():
        return state
    centroids = state.centroids.clone()
    counts = state.counts.clone()
    _fold_matched_(centroids, counts, feats, j, matched)
    return ClusterState(centroids, counts, state.n)


def _fold_matched_(centroids: torch.Tensor, counts: torch.Tensor,
                   feats: torch.Tensor, j: np.ndarray, matched: np.ndarray):
    """``_fold_matched`` in place on one table: centroids (M, D), counts
    (M,), which may be one slot of a stacked table.

    The segment sum runs in a fixed order, so the centroid bits are the
    same on every run (``index_add_`` on CUDA uses atomics, whose order —
    and with it the rounding — changes from run to run, which would break
    chunked == one-shot byte identity): rows are grouped by cluster on the
    host, each cluster's rows are placed in batch order into their own
    row of a zero-padded (clusters, max rows, D) block with plain stores,
    and the block is summed along its middle axis.
    """
    rows = np.nonzero(matched)[0]
    if len(rows) == 0:
        return
    seg = j[rows].astype(np.int64)
    order = np.argsort(seg, kind="stable")          # batch order per cluster
    seg, rows = seg[order], rows[order]
    uniq, first, add_cnt = np.unique(seg, return_index=True,
                                     return_counts=True)
    pos = np.repeat(np.arange(len(uniq)), add_cnt)
    rank = np.arange(len(seg)) - first[pos]
    dev = feats.device
    D = feats.shape[1]
    block = torch.zeros((len(uniq), int(add_cnt.max()), D),
                        dtype=torch.float32, device=dev)
    block[torch.from_numpy(pos).to(dev), torch.from_numpy(rank).to(dev)] = \
        feats[torch.from_numpy(rows).to(dev)]
    feat_sum = block.sum(1)
    slots = torch.from_numpy(uniq).to(dev)
    old_cnt = counts[slots]
    new_cnt = old_cnt + torch.from_numpy(add_cnt.astype(np.int32)).to(dev)
    denom = torch.clamp(new_cnt, min=1).float()[:, None]
    folded = (centroids[slots] * old_cnt.float()[:, None]
              + feat_sum) / denom
    centroids[slots] = folded
    counts[slots] = new_cnt


def _pad_bucket(n: int) -> int:
    """Next power of two >= n (min 8): the unmatched rows are gathered into
    O(log B) distinct shapes, as in the JAX package."""
    p = 8
    while p < n:
        p *= 2
    return p


def _scan_unmatched(state: ClusterState, sub: torch.Tensor,
                    valid: torch.Tensor, threshold: float):
    """Sequential rule over the gathered unmatched rows; padded rows
    (valid False) are no-ops and return id -1."""
    scan = _Scan(state, threshold)
    ids = scan._one.run(sub[None], valid[None])[0]
    return scan.state(), ids


class _StackedScan:
    """The sequential rule over W stream slots at once, in place on a
    stacked state (centroids (W, M, D), counts (W, M), n (W,)): ``step``
    assigns row t of every slot together and returns the W cluster ids; a
    slot whose ``valid`` is False is a no-op that returns -1. Each slot
    gets the bits of a one-slot scan of its own table, provided the
    (W, M, D) distance sum reduces each row as the (1, M, D) one does (the
    CPU tests and ``chip_smoke.py`` on the card hold the stacked tail
    against solo scans)."""

    def __init__(self, state: ClusterState, threshold: float):
        self.cent, self.counts, self.n = state
        dev = self.cent.device
        W, self.M = self.counts.shape
        # the (W * M) rows of the tables, addressed as slot * M + cid; the
        # views follow the in-place updates. The step is host-bound (a
        # few dozen small ops a row), so nothing is recomputed per step
        # that can be made once here.
        self.flat_cent = self.cent.view(W * self.M, -1)
        self.flat_counts = self.counts.view(-1)
        self.n_col = self.n.view(W, 1)
        self.base = (None if W == 1
                     else torch.arange(W, device=dev) * self.M)
        self.t2 = threshold_sq(threshold).to(dev)
        self.cols = torch.arange(self.M, device=dev)[None, :]

    def step(self, f: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        diff = self.cent - f[:, None, :]
        d2 = torch.where(self.cols < self.n_col, (diff * diff).sum(-1),
                         float("inf"))
        best, j = d2.min(1)                 # first index of the minimum
        make_new = ~(best <= self.t2) & (self.n < self.M) & valid
        # if full and nothing within T: the paper evicts the smallest; here
        # the object joins the nearest cluster and the ingestor evicts
        # between batches
        cid = torch.where(make_new, self.n.long(), j)
        at = cid if self.base is None else self.base + cid
        cnt = self.flat_counts.index_select(0, at)
        old_c = self.flat_cent.index_select(0, at)
        new_count = torch.where(make_new, 1, cnt + 1)
        new_c = torch.where(make_new[:, None], f,
                            old_c + (f - old_c) / new_count[:, None])
        self.flat_cent.index_copy_(0, at,
                                   torch.where(valid[:, None], new_c, old_c))
        self.flat_counts.index_copy_(0, at,
                                     torch.where(valid, new_count, cnt))
        self.n.add_(make_new)               # one more where a cluster opened
        return torch.where(valid, cid, -1)

    def run(self, sub: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Step row t of every slot for t = 0 .. P-1: sub (W, P, D), valid
        (W, P), P >= 1. Returns the ids (W, P) int32 (-1 where not
        valid)."""
        ids = [self.step(f, v)
               for f, v in zip(sub.transpose(0, 1), valid.t())]
        return torch.stack(ids, 1).to(torch.int32)


def _scan_unmatched_stacked(state: ClusterState, sub: torch.Tensor,
                            valid: torch.Tensor, threshold: float
                            ) -> torch.Tensor:
    """``_scan_unmatched`` for W slots in one pass, in place on the stacked
    ``state``: sub (W, P, D) gathered rows, valid (W, P). Returns the ids
    (W, P) int32 (-1 where not valid); P >= 1."""
    return _StackedScan(state, threshold).run(sub, valid)


def cluster_fused(state: ClusterState, feats, threshold: float):
    """Vectorized fast-path clustering. Returns (state, ids (B,)).

    Phase 1 (parallel, kernel): distances + fused threshold -> matched.
    Matched objects fold into their batch-start centroids via one segment
    sum. The sequential rule runs ONLY over the gathered unmatched rows,
    padded to a power-of-two bucket; ids are scattered back into batch
    order. Equivalent to ``cluster_scan`` wherever ``cluster_batched`` is.
    """
    dev = state.centroids.device
    feats = _as_feats(feats, dev)
    if len(feats) == 0:
        return state, torch.zeros((0,), dtype=torch.int32, device=dev)
    j, matched = _phase1(state, feats, threshold)
    # focuslint: disable=host-sync -- the one designed per-batch fetch:
    # (j, matched) decide which rows the fold and the sequential rule
    # touch; packed into one tensor, one copy, as the reference's one
    # device_get
    host = torch.stack((j, matched.to(j.dtype))).cpu().numpy()
    j_np, matched_np = host[0], host[1].astype(bool)
    state = _fold_matched(state, feats, j_np, matched_np)

    ids = j_np.astype(np.int32)
    unmatched_idx = np.nonzero(~matched_np)[0]
    U = len(unmatched_idx)
    if U:
        P = _pad_bucket(U)
        gather = np.zeros((P,), np.int64)
        gather[:U] = unmatched_idx
        sub = feats[torch.from_numpy(gather).to(dev)]
        valid = torch.from_numpy(np.arange(P) < U).to(dev)
        state, sub_ids = _scan_unmatched(state, sub, valid, threshold)
        # focuslint: disable=host-sync -- same designed sync boundary:
        # winner ids feed the host-side fold
        ids[unmatched_idx] = sub_ids.cpu().numpy()[:U]
    return state, torch.from_numpy(ids).to(dev)


CLUSTER_FNS = {
    "scan": cluster_scan,
    "batched": cluster_batched,
    "fused": cluster_fused,
}


# ---------------------------------------------------------------------------
# host-side eviction helper (keeps cluster count at M, paper §4.2)
# ---------------------------------------------------------------------------

def evict_smallest(state: ClusterState, frac: float = 0.25):
    """Evict the smallest ``frac`` of live clusters; returns
    (compacted_state, evicted_slot_ids, slot_remap (M,) old->new or -1)."""
    dev = state.centroids.device
    centroids = state.centroids.cpu().numpy()
    counts = state.counts.cpu().numpy()
    n = int(state.n)
    M = centroids.shape[0]
    if n == 0:
        return state, np.zeros((0,), np.int32), np.full((M,), -1, np.int32)
    k = max(1, int(n * frac))
    order = np.argsort(counts[:n])          # smallest first
    evicted = np.sort(order[:k]).astype(np.int32)
    keep = np.sort(order[k:]).astype(np.int32)
    remap = np.full((M,), -1, np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    new_centroids = np.zeros_like(centroids)
    new_counts = np.zeros_like(counts)
    new_centroids[: len(keep)] = centroids[keep]
    new_counts[: len(keep)] = counts[keep]
    new_state = ClusterState(
        torch.from_numpy(new_centroids).to(dev),
        torch.from_numpy(new_counts).to(dev),
        torch.tensor(len(keep), dtype=torch.int32, device=dev))
    return new_state, evicted, remap
