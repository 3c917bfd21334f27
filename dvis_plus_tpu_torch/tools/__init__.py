"""Command-line tools of the port: the synthetic-data writer, the offline
VPS / VSS scorer, the dataset converters, the zoo-weights runbook and the
serving-deviation AP harness (``python -m dvis_plus_tpu_torch.tools.<name>``)."""
