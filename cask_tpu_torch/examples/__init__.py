"""Runnable examples of the port, twins of the repository's ``examples/``:
``python -m cask_tpu_torch.examples.<name>`` runs one on the card."""
