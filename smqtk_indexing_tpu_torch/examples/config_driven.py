"""
Config-driven (service-style) instantiation on the card: the port's
counterpart of ``examples/config_driven.py``. An index is described
entirely as a JSON document (the plugin contract the SMQTK ecosystem
builds services on) and constructed with ``from_config_dict`` against the
port's discovered implementations; the bare type name resolves to the
port's class.

    python -m smqtk_indexing_tpu_torch.examples.config_driven \\
        [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from smqtk_indexing_tpu_torch.core.configuration import (
    from_config_dict, to_config_dict,
)
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)


def main(device: str = "cuda") -> list:
    """Build and query the configured index on ``device``; returns the
    top-3 (uid, distance) pairs of element 42."""
    config = {
        "type": "IvfNearestNeighborsIndex",
        "IvfNearestNeighborsIndex": {
            "metric": "euclidean",
            "n_lists": 16,
            "nprobe": 4,
            "kmeans_iterations": 5,
            "random_seed": 0,
            "device": device,
        },
    }
    index = from_config_dict(config, NearestNeighborsIndex.get_impls())
    print("instantiated:", type(index).__module__, type(index).__name__)

    rng = np.random.default_rng(0)
    elems = [DescriptorMemoryElement(i, rng.normal(size=32).astype(np.float32))
             for i in range(1000)]
    index.build_index(elems)
    res, dists = index.nn(elems[42], 3)
    top = [(e.uuid(), round(d, 3)) for e, d in zip(res, dists)]
    print("top-3:", top)
    if res[0].uuid() != 42:
        raise RuntimeError(f"element 42 did not find itself: {top}")

    # The live instance serializes back to a JSON-compliant document.
    print("round-trip config json:",
          json.dumps(to_config_dict(index))[:120], "...")
    return top


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
