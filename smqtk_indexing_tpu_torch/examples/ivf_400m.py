"""
IVF residual-OPQ16 at 402,653,184 vectors on one card: the port's
counterpart of ``examples/ivf_400m.py``, the code tier's capacity point
(the reference's 'OPQ16,IVF16384,PQ16').

This is ``smqtk_indexing_tpu_torch.examples.ivf_100m`` at 64 chunks with
the SQ8 phase skipped (an int8-a-dim copy would need N bytes, 51 GB) and
the OPQ rotation on: 6.4 GB of uint8 codes and 1.6 GB of f32 row stats
on the card; an assignment-only pass for the CSR, then the PQ ingest;
``ivf_query_dma_tiled_table_pq`` (K8) in score mode at B=128 and 1,024,
recall against the wide-probe ADC oracle over the same codes.

    python -m smqtk_indexing_tpu_torch.examples.ivf_400m [--device cuda]

Raw-PQ / no-OPQ variants: ``SMQTK_IVF100M_OPQ=0 SMQTK_IVF100M_RAW_PQ=1``.
"""
import os
import runpy


def main() -> None:
    """Preset the switches (as the JAX preset does, unless already set)
    and run the 100M example as ``__main__``, with this command line."""
    os.environ.setdefault("SMQTK_IVF100M_CHUNKS", "64")
    os.environ.setdefault("SMQTK_IVF100M_NO_SQ8", "1")
    if os.environ.get("SMQTK_IVF100M_OPQ", "1") != "0":
        os.environ["SMQTK_IVF100M_OPQ"] = "1"
    else:
        os.environ.pop("SMQTK_IVF100M_OPQ", None)
    runpy.run_module("smqtk_indexing_tpu_torch.examples.ivf_100m",
                     run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
