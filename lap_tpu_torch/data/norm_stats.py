"""Normalization statistics: streaming mean/var + histogram quantiles.

Parity with lihzha/lap ``shared/normalize_adapter.py`` (float64 shifted-
moment accumulation, 4096-bin histogram quantiles, JSON caching) and
``datasets/utils/statistics.py`` (transition-weighted global grouping).

Copied from ``lap_tpu/data/norm_stats.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

NUM_QUANTILE_BINS = 4096


def histogram_quantile(
    data: np.ndarray, g_min: np.ndarray, g_max: np.ndarray, q: float,
    num_bins: int = NUM_QUANTILE_BINS,
) -> np.ndarray:
    """Reference quantile semantics (normalize_adapter.py:236-268): 4096-bin
    per-dim histograms over [min-1e-12, max+1e-12], returning the LEFT edge
    of the bin where the cumulative count first reaches q * total."""
    data = np.asarray(data, np.float64)
    g_min = np.asarray(g_min, np.float64)
    g_max = np.asarray(g_max, np.float64)
    dims = g_min.shape[0]
    out = np.zeros(dims)
    for d in range(dims):
        if not np.isfinite(g_min[d]) or not np.isfinite(g_max[d]) or g_min[d] == g_max[d]:
            out[d] = g_min[d] if np.isfinite(g_min[d]) else 0.0
            continue
        edges = np.linspace(g_min[d] - 1e-12, g_max[d] + 1e-12, num_bins + 1)
        h, _ = np.histogram(data[:, d], bins=edges)
        total = h.sum()
        if total == 0:
            out[d] = g_min[d]
            continue
        c = np.cumsum(h)
        idx = min(int(np.searchsorted(c, q * total, side="left")), num_bins - 1)
        out[d] = edges[idx]
    return out


class RunningStats:
    """Streaming per-dimension stats over [N, D] batches."""

    def __init__(self, dim: int):
        self.dim = dim
        self.count = 0
        self.sum = np.zeros(dim, np.float64)
        self.sumsq = np.zeros(dim, np.float64)
        self.min = np.full(dim, np.inf)
        self.max = np.full(dim, -np.inf)
        self._hist = None
        self._hist_edges = None
        self._buffer = []
        self._buffered = 0

    def update(self, batch: np.ndarray):
        batch = np.asarray(batch, dtype=np.float64).reshape(-1, self.dim)
        self.count += batch.shape[0]
        self.sum += batch.sum(axis=0)
        self.sumsq += (batch**2).sum(axis=0)
        self.min = np.minimum(self.min, batch.min(axis=0))
        self.max = np.maximum(self.max, batch.max(axis=0))
        if self._hist is None:
            self._buffer.append(batch)
            self._buffered += batch.shape[0]
            # Buffer up to 1M rows (~256 MB at 32 dims f64) so finetune-scale
            # datasets get the reference's EXACT quantile semantics; beyond
            # that, freeze into the approximate streaming histogram.
            if self._buffered >= 1_000_000:
                self._freeze_hist()
        else:
            self._add_hist(batch)

    def _freeze_hist(self):
        data = np.concatenate(self._buffer, axis=0)
        lo = np.minimum(self.min, data.min(axis=0))
        hi = np.maximum(self.max, data.max(axis=0))
        span = np.where(hi - lo < 1e-12, 1.0, hi - lo)
        self._hist_edges = (lo - 0.01 * span, hi + 0.01 * span)
        self._hist = np.zeros((self.dim, NUM_QUANTILE_BINS), np.int64)
        self._buffer = None
        self._add_hist(data)

    def _add_hist(self, batch):
        lo, hi = self._hist_edges
        idx = ((batch - lo) / (hi - lo) * NUM_QUANTILE_BINS).astype(np.int64)
        idx = np.clip(idx, 0, NUM_QUANTILE_BINS - 1)
        # One scatter-add on the flattened (dim, bins) table instead of a
        # python loop over dims: the full-pass stats sweep is O(frames).
        flat = idx + np.arange(self.dim, dtype=np.int64) * NUM_QUANTILE_BINS
        counts = np.bincount(flat.ravel(), minlength=self.dim * NUM_QUANTILE_BINS)
        self._hist += counts.reshape(self.dim, NUM_QUANTILE_BINS)

    def _quantile(self, q: float) -> np.ndarray:
        if self._hist is None:
            data = (
                np.concatenate(self._buffer, axis=0)
                if self._buffer
                else np.zeros((1, self.dim))
            )
            return histogram_quantile(data, self.min, self.max, q)
        # Streaming fallback (dataset exceeded the in-memory buffer): the
        # final min/max were unknown when the histogram froze, so this is
        # approximate to ~span/4096 — the reference holds every transition
        # in RAM instead (normalize_adapter.py:89-280).
        lo, hi = self._hist_edges
        out = np.zeros(self.dim)
        for d in range(self.dim):
            cdf = np.cumsum(self._hist[d]) / max(self._hist[d].sum(), 1)
            bin_idx = int(np.searchsorted(cdf, q))
            bin_idx = min(bin_idx, NUM_QUANTILE_BINS - 1)
            out[d] = lo[d] + (bin_idx + 0.5) / NUM_QUANTILE_BINS * (hi[d] - lo[d])
        return out

    def finalize(self):
        from lap_tpu_torch.policies.model_transforms import NormStats

        n = max(self.count, 1)
        mean = self.sum / n
        var = np.maximum(self.sumsq / n - mean**2, 0.0)
        return NormStats(
            mean=mean.astype(np.float32),
            std=np.sqrt(var).astype(np.float32),
            q01=self._quantile(0.01).astype(np.float32),
            q99=self._quantile(0.99).astype(np.float32),
            min=self.min.astype(np.float32),
            max=self.max.astype(np.float32),
            num_transitions=int(self.count),
        )


def merge_norm_stats(stats_list: list, dim: int):
    """Transition-weighted merge of per-dataset / per-host NormStats
    (reference statistics.py:95-228 semantics): exact pooled mean/variance
    via the parallel-variance identity; quantiles/min/max take the
    elementwise envelope (q01 = min, q99 = max) across members.
    """
    from lap_tpu_torch.policies.model_transforms import NormStats

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float64)
        if len(x) >= dim:
            return x[:dim]
        return np.pad(x, (0, dim - len(x)), constant_values=fill)

    members = [s for s in stats_list if s is not None and s.num_transitions > 0]
    if not members:
        return NormStats(
            mean=np.zeros(dim, np.float32), std=np.ones(dim, np.float32),
            q01=np.zeros(dim, np.float32), q99=np.zeros(dim, np.float32),
            min=np.zeros(dim, np.float32), max=np.zeros(dim, np.float32),
        )
    total = sum(s.num_transitions for s in members)
    mean = sum(pad(s.mean) * s.num_transitions for s in members) / total
    var = (
        sum(
            s.num_transitions * (pad(s.std) ** 2 + (pad(s.mean) - mean) ** 2)
            for s in members
        )
        / total
    )
    return NormStats(
        mean=mean.astype(np.float32),
        std=np.sqrt(var).astype(np.float32),
        q01=np.min([pad(s.q01) for s in members], axis=0).astype(np.float32),
        q99=np.max([pad(s.q99) for s in members], axis=0).astype(np.float32),
        # Reference semantics (statistics.py:224-229): min/max are ZERO-padded
        # for dims a member lacks, so the global envelope saturates at 0
        # wherever short members dominate (padded action dims stay 0 anyway).
        min=np.min([pad(s.min) for s in members], axis=0).astype(np.float32),
        max=np.max([pad(s.max) for s in members], axis=0).astype(np.float32),
        num_transitions=int(total),
    )


def compute_norm_stats(frames, keys=("state", "actions")) -> dict:
    """One pass over an iterable of frames -> {key: NormStats}."""
    trackers: dict[str, RunningStats] = {}
    for frame in frames:
        for key in keys:
            value = frame.get(key) if key != "state" else frame["observation"]["state"]
            if value is None:
                continue
            arr = np.asarray(value, dtype=np.float64).reshape(-1, np.shape(value)[-1])
            if key not in trackers:
                trackers[key] = RunningStats(arr.shape[-1])
            trackers[key].update(arr)
    return {k: t.finalize() for k, t in trackers.items()}


def save_norm_stats(path: str | Path, stats: dict, *, extra: dict | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"norm_stats": {k: v.to_dict() for k, v in stats.items()}}
    payload.update(extra or {})
    path.write_text(json.dumps(payload))


def load_norm_stats(path: str | Path) -> dict | None:
    from lap_tpu_torch.policies.model_transforms import NormStats

    path = Path(path)
    if not path.exists():
        return None
    raw = json.loads(path.read_text())
    return {k: NormStats.from_dict(v) for k, v in raw.get("norm_stats", raw).items()}
