"""Examples of the port, run as modules (``python -m pathway_tpu_torch.examples.<name>``)."""
