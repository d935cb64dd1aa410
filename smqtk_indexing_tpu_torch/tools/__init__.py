"""Card probes of the port: the counterparts of the JAX package's
``tools/probe_int8_mxu.py`` (K10) and ``tools/stage1_analysis.py`` (K9)."""
