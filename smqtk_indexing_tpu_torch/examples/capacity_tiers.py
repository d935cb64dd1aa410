"""
The storage-capacity ladder: one index API, five residency tiers, on the
PyTorch port (counterpart of ``examples/capacity_tiers.py``).

The reference exposes FAISS codecs through factory strings; here the
same ``dtype`` axis composes with several devices and host streaming.
Capacities are arithmetic for one 80 GB card at d=128 (the stored bytes
a vector, its row statistics included), not measurements:

| tier                  | bytes a vector (d=128) | 80 GB card      | exact? |
|-----------------------|------------------------|-----------------|--------|
| float32 (default)     | 512 + 12               | ~150M vectors   | yes    |
| bfloat16              | 256 + 12               | ~300M           | ~      |
| sq8                   | 128 + 12               | ~570M           | codec  |
| pq16                  | 16 + 8                 | ~3,300M         | codec  |
| storage='host_stream' | host memory            | host memory     | yes    |
| n_devices=N           | x N cards              | x N             | yes    |

    python -m smqtk_indexing_tpu_torch.examples.capacity_tiers \\
        [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions (small shapes).
"""
import argparse

import numpy as np

from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index.factory import (
    index_from_factory_string,
)
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)


def main(device: str = "cuda") -> list:
    """Build each tier over the same 4096 x 128 rows on ``device`` and
    query one of them; returns each tier's (name, top-3 uids).

    :raises AssertionError: the query's own row is not at a tier's
        nearest distance (a codec tier's rows that share its code tie
        with it, and the port does not promise the lowest row id first
        among exact ties).
    """
    rng = np.random.default_rng(0)
    n, d = 4096, 128
    centers = rng.normal(size=(64, d)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 64, n)]
          + rng.normal(size=(n, d)).astype(np.float32) * 0.3)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    probe = elems[123]

    tiers = [
        ("float32 (exact)", FlatNearestNeighborsIndex(device=device)),
        ("bfloat16", FlatNearestNeighborsIndex(dtype="bfloat16",
                                               device=device)),
        ("SQ8 via factory", index_from_factory_string("IDMap,SQ8",
                                                      device=device)),
        ("PQ16 via factory", index_from_factory_string("PQ16",
                                                       device=device)),
        ("host stream", FlatNearestNeighborsIndex(storage="host_stream",
                                                  device=device)),
    ]
    out = []
    for name, idx in tiers:
        idx.build_index(elems)
        neighbors, dists = idx.nn(probe, 3)
        print(f"{name:>18}: top-3 uids "
              f"{[e.uuid() for e in neighbors]}, d0={dists[0]:.4f}")
        if neighbors[0].uuid() != 123:
            tied = [e.uuid() for e, dist in zip(*idx.nn(probe, 64))
                    if dist == dists[0]]
            assert 123 in tied, (name, tied)
        out.append((name, [e.uuid() for e in neighbors]))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
