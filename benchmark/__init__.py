"""
The benchmark of the PyTorch / CUDA port (``smqtk_indexing_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Every part of a cell is a file of its own, found by the name that
``BENCHMARK.json`` or another file gives it (``registry.py``), so a new
configuration, traffic mix or metric is a new file and no existing file
changes:

- ``configs/<config>.json``: the deployment: index class and arguments,
  data recipe and sizes, source, cuts, the guarantee and the limits of
  the check that decides ``correct``;
- ``traffic/<mix>.json``: the loop, batch size, k and query pool;
- ``recipes/<recipe>.py``: makes the rows and the query pool from the seed;
- ``loops/<loop>.py``: drives the index over the measured window;
- ``references/<reference>.py``: the plain reference and the comparison;
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer.

The harness imports nothing of JAX or of the JAX package
(``guard.py`` checks ``sys.modules`` after every run).
"""
