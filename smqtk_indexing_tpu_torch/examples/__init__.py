"""Runnable drives of the port's paths at their real sizes (run each as
``python -m smqtk_indexing_tpu_torch.examples.<name>``)."""
