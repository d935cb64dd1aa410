"""
Clustered synthetic descriptors: the recipe of the repository's GIST1M and
Deep1M / Deep10M stand-ins (``clusters`` centres uniform in [0, scale]^dim,
each point a uniformly chosen centre plus Gaussian noise of standard
deviation ``noise * scale``, clipped to [0, scale]). Queries are further
draws of the same mixture, never indexed.

Everything is drawn on ``device`` by one ``torch.Generator`` seeded with
the run's seed, in a few large calls, then copied to the host once: the
index's public build takes host ``DescriptorMemoryElement``s, and the
reference reads the same host rows.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: Rows drawn a call: bounds the noise block's memory.
CHUNK_BYTES = 1 << 30


def _draw(g: torch.Generator, centers: torch.Tensor, n: int, noise: float,
          scale: float) -> np.ndarray:
    dim = centers.shape[1]
    out = np.empty((n, dim), dtype=np.float32)
    rows = max(1, CHUNK_BYTES // (4 * dim))
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        pick = torch.randint(0, centers.shape[0], (hi - lo,), generator=g,
                             device=centers.device)
        pts = torch.randn((hi - lo, dim), generator=g,
                          device=centers.device)
        pts.mul_(noise * scale).add_(centers[pick]).clamp_(0.0, scale)
        out[lo:hi] = pts.cpu().numpy()
    return out


def make(data: dict, n_queries: int, seed: int, device: str
         ) -> Tuple[np.ndarray, np.ndarray]:
    """
    :param data: the configuration's ``data``: ``n``, ``dim``,
        ``clusters``, ``noise`` (the standard deviation as a share of
        ``scale``) and ``scale``.
    :param n_queries: size of the held-out query pool.
    :param seed: the run's seed; the same seed gives the same arrays.
    :return: (rows (n, dim), queries (n_queries, dim)), float32 on the
        host.
    """
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    scale = float(data["scale"])
    centers = torch.rand((int(data["clusters"]), int(data["dim"])),
                         generator=g, device=device).mul_(scale)
    rows = _draw(g, centers, int(data["n"]), float(data["noise"]), scale)
    queries = _draw(g, centers, int(n_queries), float(data["noise"]), scale)
    return rows, queries
