"""scripts — probes of the port's kernels, run on the card with
``python -m elektronn2_tpu_torch.scripts.<name>``."""
