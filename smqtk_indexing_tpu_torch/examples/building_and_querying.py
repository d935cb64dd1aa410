"""
Building and querying an index on the card: the port's counterpart of
``examples/building_and_querying.py`` (the reference's
``examples/building_and_querying.ipynb``, a qualitative retrieval demo).
It makes clustered descriptors, queries an exact flat index, fits an ITQ
functor, builds an LSH index with a Hamming hash index, queries it with
``nn()`` and ``nn_many()``, and reloads the trained model from its cache
files.

    python -m smqtk_indexing_tpu_torch.examples.building_and_querying \\
        [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from smqtk_indexing_tpu_torch.data.data_element import DataFileElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.data.key_value import MemoryKeyValueStore
from smqtk_indexing_tpu_torch.models.hash_index.linear import LinearHashIndex
from smqtk_indexing_tpu_torch.models.lsh_functor.itq import ItqFunctor
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
    LSHNearestNeighborIndex,
)


def main(device: str = "cuda") -> int:
    """Run the demo on ``device``; returns the batched self-retrieval
    hits out of 32."""
    # 1. Some descriptors: 10 clusters of 128-d vectors standing in for
    #    image features (the notebook used butterfly images).
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(10, 128)) * 5
    elems = [
        DescriptorMemoryElement(
            f"img-{c}-{j}",
            (centers[c] + rng.normal(size=128) * 0.4).astype(np.float32))
        for c in range(10) for j in range(200)
    ]
    print(f"{len(elems)} descriptors of dim 128")

    # 2. Exact flat index.
    flat = FlatNearestNeighborsIndex(metric="euclidean", device=device)
    flat.build_index(elems)
    q = elems[42]
    neighbors, dists = flat.nn(q, 5)
    print("flat top-5:",
          [(e.uuid(), round(d, 3)) for e, d in zip(neighbors, dists)])

    with tempfile.TemporaryDirectory() as tmp:
        # 3. LSH: fit ITQ on the corpus, build the composite index with a
        #    Hamming hash index, persist the trained model to disk.
        def caches():
            return dict(
                mean_vec_cache_elem=DataFileElement(
                    os.path.join(tmp, "mean.npy")),
                rotation_cache_elem=DataFileElement(
                    os.path.join(tmp, "rot.npy")))
        functor = ItqFunctor(**caches(), bit_length=64, itq_iterations=50,
                             random_seed=0, device=device)
        functor.fit(elems)
        lsh = LSHNearestNeighborIndex(
            lsh_functor=functor,
            descriptor_set=MemoryDescriptorSet(),
            hash2uuids_kvstore=MemoryKeyValueStore(),
            hash_index=LinearHashIndex(device=device),
            distance_method="euclidean", device=device)
        lsh.build_index(elems)
        neighbors, dists = lsh.nn(q, 5)
        print("lsh  top-5:",
              [(e.uuid(), round(d, 3)) for e, d in zip(neighbors, dists)])

        # 4. Batched serving: many queries in one call.
        results = lsh.nn_many(elems[:32], 3)
        hits = sum(res[0].uuid() == e.uuid()
                   for e, (res, _) in zip(elems[:32], results))
        print(f"batched self-retrieval: {hits}/32")

        # 5. The trained ITQ model reloads from its cache elements.
        functor2 = ItqFunctor(**caches(), bit_length=64, device=device)
        if not functor2.has_model():
            raise RuntimeError("the ITQ model did not reload from its cache")
        print("ITQ model reloaded from cache: OK")
    return hits


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
