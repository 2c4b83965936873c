"""Port of the repo's tools/ that reach a TPU kernel."""
