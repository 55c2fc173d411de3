"""Drift monitoring: reference feature profiles, the online drift
monitor the servicer feeds, and the offline detector over the metrics
CSV (the JAX package's ``monitoring/``)."""
